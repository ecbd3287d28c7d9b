"""Model weights into the port: from the JAX package's numpy arrays, or
drawn from a seeded numpy Generator.

* :func:`params_from_numpy` takes a params tree of the reference
  (``LM.init``, optionally ``quantize_tree``) with every array as numpy
  -- the caller maps ``np.asarray`` over it -- and gives the port's tree:
  bfloat16 by its bits, uint32 plane words as int32 words of the same
  bits, ``{"q", "scale"}`` leaves, the stacked ``"unit"`` and the
  ``"rest"`` lists as they are.  A packed weight is recognised by its
  ``planes``/``scale``/``shape`` fields, so the port never imports the
  reference's class.
* :func:`init_numpy` draws a model's params from ``numpy``'s seeded
  Generator, leaf by leaf as ``dense_init`` does (normal * fan_in**-0.5,
  cast to bf16; zeros and constants where the reference has them): the
  same weights on any machine, with or without a GPU or JAX.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.engine import resolve_device
from repro_torch.pim.linear import _tensor_from_numpy
from .model import LM
from .qweight import PackedWeight


def params_from_numpy(tree, device=None):
    """A reference params tree of numpy arrays as the port's tensors on
    ``device`` (``None``: the GPU)."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(conv(v) for v in t)
        if all(hasattr(t, f) for f in ("planes", "scale", "shape")):
            return PackedWeight(conv(t.planes), conv(t.scale), t.shape)
        return _tensor_from_numpy(np.asarray(t)).to(dev)

    return conv(tree)


def init_numpy(cfg, seed: int, device=None):
    """Params of ``LM(cfg)`` drawn from ``np.random.default_rng(seed)`` on
    the host and placed on ``device`` (``None``: the GPU)."""
    return LM(cfg, device).init(np.random.default_rng(seed))
