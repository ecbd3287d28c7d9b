"""AdamW with cosine schedule + global-norm clipping.

The counterpart of ``repro.train.optimizer``: functional over the params
tree, every update in float32 and cast back to the param's dtype, in the
reference's order of operations.  ``torch.optim.AdamW`` is not used: it
decays weights as ``p *= 1 - lr*wd`` before the step, which rounds
differently from the reference's ``p - lr*(u + wd*p)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.convert import params_from_numpy
from .tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor      # int32 scalar
    mu: dict
    nu: dict


def init(params, cfg: OptConfig) -> OptState:
    """Zero moments in float32 beside each param, step 0 on the params'
    device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    dev = tree_leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def opt_state_from_numpy(state, device=None) -> OptState:
    """An ``OptState`` of the JAX package with numpy ``step``/``mu``/``nu``
    (the caller maps ``np.asarray`` over it) as the port's, on ``device``
    (``None``: the GPU)."""
    dev = resolve_device(device)
    return OptState(step=torch.from_numpy(np.array(state.step, np.int32))
                    .to(dev),
                    mu=params_from_numpy(state.mu, dev),
                    nu=params_from_numpy(state.nu, dev))


def schedule(step, cfg: OptConfig):
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def apply(params, grads, state: OptState, cfg: OptConfig):
    """Returns (new_params, new_state, metrics)."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                           for g in tree_leaves(grads)))
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = schedule(step, cfg)
    bc1 = 1 - cfg.b1 ** step.to(torch.float32)
    bc2 = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        u = u + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * u).to(p.dtype), m, v

    ps, treedef = tree_flatten(params)
    out = [upd(*xs) for xs in zip(ps, tree_leaves(grads),
                                  tree_leaves(state.mu),
                                  tree_leaves(state.nu))]
    new_params, new_mu, new_nu = (tree_unflatten(treedef, [o[i] for o in out])
                                  for i in range(3))
    return new_params, OptState(step, new_mu, new_nu), \
        {"grad_norm": gnorm, "lr": lr}
