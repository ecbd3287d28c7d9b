"""The train step: loss -> grads -> AdamW, with microbatch gradient
accumulation for large global batches.

The counterpart of ``repro.train.step``.  Gradients come from
``torch.autograd.grad`` over the params' leaves in the JAX package's
order; accumulation sums the microbatches' losses and gradients in
float32 in microbatch order, then divides by ``accum``, as the
reference's ``lax.scan`` does.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import replicate
from . import optimizer as opt_mod
from .tree import tree_flatten, tree_map, tree_unflatten


def _placed_like(g, p):
    """The gradient ``g`` on its parameter ``p``'s placements (a DTensor
    on a mesh; anything else as it is)."""
    if getattr(p, "placements", None) is None or \
            tuple(g.placements) == tuple(p.placements):
        return g
    return g.redistribute(p.device_mesh, p.placements)


def value_and_grad(loss_fn):
    """``jax.value_and_grad(loss_fn)``: ``fn(params, *args) -> (loss,
    grads)``, ``grads`` a tree like ``params`` with each leaf's gradient
    in the leaf's dtype (zeros where the loss does not depend on it).
    Every leaf must be a floating-point tensor."""

    def fn(params, *args):
        leaves, treedef = tree_flatten(params)
        xs = [x.detach().requires_grad_() for x in leaves]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(treedef, xs), *args)
            gs = torch.autograd.grad(loss, xs, allow_unused=True,
                                     materialize_grads=True)
        gs = [_placed_like(g, x) for g, x in zip(gs, xs)]
        return replicate(loss.detach()), tree_unflatten(treedef, gs)

    return fn


def make_train_step(model, opt_cfg, accum: int = 1):
    """Returns train_step(params, opt_state, batch) -> (p, s, metrics).

    ``accum`` > 1 splits the batch into microbatches run sequentially
    (activation memory / batch size decoupling).
    """
    grad_fn = value_and_grad(model.loss)

    def train_step(params, opt_state, batch):
        if accum == 1:
            loss, grads = grad_fn(params, batch)
        else:
            micro = tree_map(lambda x: x.reshape(
                (accum, x.shape[0] // accum) + x.shape[1:]), batch)
            loss = 0.0
            grads = tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            for i in range(accum):
                l, g = grad_fn(params, tree_map(lambda x: x[i], micro))
                loss = loss + l
                grads = tree_map(torch.add, grads, g)
            loss = loss / accum
            grads = tree_map(lambda g: g / accum, grads)

        params, opt_state, metrics = opt_mod.apply(
            params, grads, opt_state, opt_cfg)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def jit_train_step(model, opt_cfg, accum: int = 1):
    """The reference's compiled step under its name.  The port runs the
    step eagerly, op by op, so there is nothing to compile and no buffer
    to donate: this is :func:`make_train_step`."""
    return make_train_step(model, opt_cfg, accum)
