"""Storage-mode quantized weights for serving (the Compute RAM dual-mode
idea applied at model scale).

The counterpart of ``repro.models.qweight``.  ``quantize_tree`` converts
selected weight leaves into compact storage:

* ``bits=8``: ``{"q": int8, "scale": f32[out]}``  (2x memory reduction)
* ``bits=4``: ``PackedWeight`` with planes ``int32[4, in//32, out]`` (the
  uint32 plane words of the reference, bit for bit: the port's word
  convention, ``kernels/ref.py``) and ``scale: f32[out]`` -- the buffer
  format the bit-serial kernels consume (4x reduction vs bf16).

``dq(leaf)`` expands either form (or passes raw tensors through) at the
point of use.  The reference registers ``PackedWeight`` as a pytree;
here :func:`tree_map` and :func:`tree_leaves` walk the same trees
(dicts, lists, tuples and ``PackedWeight`` nodes).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref as kref

# weights worth quantizing (2D+ matmul operands)
_QUANT_NAMES = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
                "in_proj", "out_proj", "x_proj", "dt_w", "wx", "wy",
                "wi", "wr", "out", "embed", "head"}


class PackedWeight:
    """Bit-plane packed weight: planes int32 (bits, K//32, N) + scale."""

    def __init__(self, planes, scale, shape):
        self.planes = planes
        self.scale = scale
        self.shape = tuple(shape)


def tree_map(fn, tree, *rest):
    """``fn`` over the tensor leaves of ``tree`` (and the same positions
    of ``rest``), keeping dicts, lists, tuples and ``PackedWeight``
    nodes."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if isinstance(tree, PackedWeight):
        return PackedWeight(fn(tree.planes, *(r.planes for r in rest)),
                            fn(tree.scale, *(r.scale for r in rest)),
                            tree.shape)
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The tensor leaves of ``tree`` in :func:`tree_map` order."""
    out = []
    tree_map(out.append, tree)
    return out


def _quantize_leaf(w, bits: int, stacked: bool = False):
    """``stacked``: leading dim is the layer axis -- every produced leaf
    keeps it so the layer loop can slice per layer.

    The reference's order of operations, so planes, scales and codes are
    bit-identical to it: float32 ``amax / qmax`` (a true division, as
    the reference computes it outside ``jit``), ``round`` half to even,
    ``clip``."""
    wf = w.to(torch.float32)
    qmax = (1 << (bits - 1)) - 1
    if stacked:
        flat = wf.reshape(wf.shape[0], -1, wf.shape[-1])    # (L, K, N)
        amax = torch.clamp(torch.amax(torch.abs(flat), dim=1), min=1e-8)
        scale = (amax / qmax).to(torch.float32)             # (L, N)
        q = torch.clamp(torch.round(flat / scale[:, None, :]),
                        -qmax - 1, qmax)
        if bits == 4 and flat.shape[1] % 32 == 0:
            planes = torch.stack([
                kref.pack_bitplanes(qq.to(torch.int8), 4, axis=0)
                for qq in q])                               # (L,4,K/32,N)
            return PackedWeight(planes, scale, w.shape[1:])
        return {"q": q.to(torch.int8).reshape(w.shape), "scale": scale}
    flat = wf.reshape(-1, wf.shape[-1])
    amax = torch.clamp(torch.amax(torch.abs(flat), dim=0), min=1e-8)
    scale = (amax / qmax).to(torch.float32)
    q = torch.clamp(torch.round(flat / scale), -qmax - 1, qmax)
    if bits == 4 and flat.shape[0] % 32 == 0:
        planes = kref.pack_bitplanes(q.to(torch.int8), 4, axis=0)
        return PackedWeight(planes, scale, w.shape)
    return {"q": q.to(torch.int8).reshape(w.shape), "scale": scale}


def dq(leaf, dtype=torch.bfloat16):
    """Dequantize a (possibly) quantized weight leaf."""
    if isinstance(leaf, PackedWeight):
        w = kref.unpack_bitplanes(leaf.planes, axis=0, signed=True)
        w = w.to(torch.float32) * leaf.scale
        return w.reshape(leaf.shape).to(dtype)
    if isinstance(leaf, dict) and "q" in leaf:
        return (leaf["q"].to(torch.float32) * leaf["scale"]).to(dtype)
    return leaf


def quantize_tree(params, bits: int = 8, names=None):
    """Quantize matching 2D+ weight leaves of a params tree.

    Leaves under a stacked "unit" keep their leading layer axis.
    """
    names = names or _QUANT_NAMES

    def walk(tree, stacked=False):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                min_nd = 3 if stacked else 2
                if k in names and isinstance(v, torch.Tensor) \
                        and v.ndim >= min_nd:
                    out[k] = _quantize_leaf(v, bits, stacked)
                else:
                    out[k] = walk(v, stacked or k == "unit")
            return out
        if isinstance(tree, list):
            return [walk(v, stacked) for v in tree]
        return tree

    return walk(params)


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))
