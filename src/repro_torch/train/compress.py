"""Gradient compression for data-parallel all-reduce.

The counterpart of ``repro.train.compress``.  ``compressed_psum`` sums
int8-quantized values (+ one f32 scale per leaf) instead of f32:

    g_q = round(g / s),  s = max|g| / 127        (per leaf, per shard)
    sum = psum(g_q * s_local)  ->  communicated as int-scaled payloads

The quantization error is unbiased per step (symmetric rounding) and
bounded by ``max|g| / 127``.  The reference runs inside ``shard_map``
over named mesh axes; here each rank of a ``torch.distributed`` process
group holds its own shard and the group is an argument: the reference's
``pmax`` of the scale is an ``all_reduce(MAX)`` and its int32 ``psum``
an ``all_reduce(SUM)``.  With no group (one shard) nothing is
communicated and the result is the quantize-dequantize alone.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .step import value_and_grad
from .tree import tree_map


def quantize_leaf(g, bits: int = 8):
    """``(int8 codes, f32 scale)``.  The scale is ``max(amax, 1e-12)``
    times the float32 reciprocal of ``qmax``: XLA compiles the
    reference's division by the constant so, and a true division differs
    from it by one ulp for some ``amax``."""
    qmax = (1 << (bits - 1)) - 1
    amax = torch.max(torch.abs(g.to(torch.float32)))
    scale = torch.clamp(amax, min=1e-12) * torch.tensor(
        1 / qmax, dtype=torch.float32, device=amax.device)
    q = torch.clamp(torch.round(g.to(torch.float32) / scale),
                    -qmax - 1, qmax).to(torch.int8)
    return q, scale


def dequantize_leaf(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum(tree, group=None, bits: int = 8):
    """Sum a tree of per-rank gradients over ``group`` with int8 payloads.

    ``group``: the process group whose ranks hold the shards
    (``torch.distributed.group.WORLD`` for every rank), or ``None`` for a
    single shard.  The int8 values are widened to int32 for the
    reduction, as in the reference, plus one f32 scale per leaf and rank.
    """
    def one(g):
        _, scale = quantize_leaf(g, bits)
        # all shards must agree on a scale: use the max over the group
        smax = scale.clone()
        if group is not None:
            dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
        q = torch.clamp(torch.round(g.to(torch.float32) / smax),
                        -(1 << (bits - 1)) + 0, (1 << (bits - 1)) - 1
                        ).to(torch.int8)
        total = q.to(torch.int32)
        if group is not None:
            dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        return (total.to(torch.float32) * smax).to(g.dtype)
    return tree_map(one, tree)


def make_compressed_grad_fn(loss_fn, group=None, bits: int = 8):
    """value_and_grad with int8-compressed data-parallel reduction.

    ``loss_fn(params, batch) -> scalar``; params replicated over the
    group's ranks, ``batch`` this rank's shard of the global batch.
    Returns a function (params, batch) -> (mean_loss, summed_grads /
    n_shards), the same on every rank.
    """
    n = 1 if group is None else dist.get_world_size(group)
    grad_fn = value_and_grad(loss_fn)

    def local(params, batch):
        loss, grads = grad_fn(params, batch)
        grads = compressed_psum(grads, group, bits)
        if group is not None:
            dist.all_reduce(loss, op=dist.ReduceOp.SUM, group=group)
        return loss / n, tree_map(lambda g: g / n, grads)

    return local
