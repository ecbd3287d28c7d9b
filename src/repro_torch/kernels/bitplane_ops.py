"""Bit-plane arithmetic: ripple adds and the lane-axis popcount fold.

The counterpart of ``repro.kernels.bitplane_ops``.  The compiled
executor's packed interior (``core/compiler.py``) represents per-column
integers as *bit planes*: plane ``i`` is one main-array row's repr value
-- ``(cols,)`` bool, or ``(W,)`` int32 words with 32 columns per word.
Arithmetic on such integers is pure bitwise logic (the full adder of
the block's carry chain).

* :func:`planes_add` -- an m-bit ripple-carry add/sub over plane lists
  (5 bitwise ops per bit), plain torch.
* :func:`lane_fold` -- the reduction ``sum_t x_t mod 2^width`` over the
  lane (tuple) axis of lane-shaped planes: a *positional popcount*, the
  inner loop of every dot-product accumulator.  Packed planes on a CUDA
  device run the hand-written kernel (:func:`lane_fold_cuda`,
  ``csrc/lane_fold.cu``) through the ``repro_torch::lane_fold``
  operator (:func:`lane_fold_op`), which a traced graph holds as one
  node; planes on the CPU, and bool planes anywhere, run the plain
  torch carry-save tree (:func:`lane_fold_torch`).

Both paths are exact (mod ``2**width``) and bit-identical.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = [
    "planes_add", "lane_fold", "lane_fold_torch", "lane_fold_cuda",
    "lane_fold_op", "use_kernel_fold", "LANE_FOLD_MAX_WIDTH",
]

#: widest fold the CUDA kernel takes (accumulator planes in registers);
#: must equal LANE_FOLD_MAX_WIDTH in csrc/lane_fold.cu.
LANE_FOLD_MAX_WIDTH = 32


def _fa(a, b, c):
    """Bitwise full adder on mask tensors: returns (sum, carry_out)."""
    axb = a ^ b
    return axb ^ c, (a & b) | (c & axb)


def _fs(a, b, c):
    """Bitwise full subtractor (a - b - borrow): (diff, borrow_out)."""
    axb = a ^ b
    return axb ^ c, (~a & b) | (c & ~axb)


def _add1(a, b, c, sub: bool):
    """One ripple step where any of a/b/c may be None (known zero).

    Subtraction is NOT commutative in (a, b): the zero-elision cases are
    handled per side (0 - b borrows where b|c; a - 0 borrows where ~a&c).
    """
    if a is None and b is None:           # 0 op 0 op c
        return c, (c if sub else None)
    if a is None:                         # 0 op b
        if sub:
            # 0 - b - c: diff = b ^ c, borrow = b | c
            if c is None:
                return b, b
            return b ^ c, b | c
        if c is None:
            return b, None
        return b ^ c, b & c
    if b is None:                         # a op 0
        if c is None:
            return a, None
        if sub:
            # a - 0 - c: diff = a ^ c, borrow = ~a & c
            return a ^ c, ~a & c
        return a ^ c, a & c
    if c is None:
        if sub:
            return a ^ b, ~a & b
        return a ^ b, a & b
    return (_fs if sub else _fa)(a, b, c)


def planes_add(a, b, cin=None, *, sub: bool = False, width=None):
    """Ripple add/sub of two bit-plane lists.

    ``a`` and ``b`` are sequences of same-dtype mask tensors (bool planes
    or packed int32 words), least-significant first; ``None`` entries
    (and a ``None`` ``cin``) are known-zero planes and cost no ops.
    Shorter inputs are zero-extended.  Returns ``(planes, carry_out)``
    of length ``width`` (default ``max(len(a), len(b))``); both the
    planes and the carry may be ``None`` (known zero).  For ``sub`` the
    carry is the borrow.  Exact mod ``2**width`` with the exact final
    carry/borrow -- the same contract as the engine's OP_FA/OP_FS chain.
    """
    m = max(len(a), len(b)) if width is None else width
    out = []
    c = cin
    for i in range(m):
        ai = a[i] if i < len(a) else None
        bi = b[i] if i < len(b) else None
        s, c = _add1(ai, bi, c, sub)
        out.append(s)
    return out, c


def _tree_fold(planes, width: int):
    """Pairwise carry-save ripple-fold over the leading lane axis.

    ``planes``: list of ``(T, ...)`` mask tensors (entries may be None).
    Returns a list of ``width`` base-shaped planes == the mod-2**width
    sum over lanes.  Associativity of modular addition makes any
    pairing order exact, so the tree halves T each level.
    """
    planes = list(planes[:width])
    planes += [None] * (width - len(planes))
    T = next(p.shape[0] for p in planes if p is not None)
    while T > 1:
        h = T // 2
        a = [None if p is None else p[:h] for p in planes]
        b = [None if p is None else p[h:2 * h] for p in planes]
        s, _ = planes_add(a, b, width=width)
        if T % 2:                      # odd lane rides along to next level
            def cat(si, ti):
                if si is None and ti is None:
                    return None
                ref = si if si is not None else ti
                left = (ref.new_zeros((h,) + tuple(ref.shape[1:]))
                        if si is None else si)
                right = (ref.new_zeros((1,) + tuple(ref.shape[1:]))
                         if ti is None else ti)
                return torch.cat([left, right])
            tail = [None if p is None else p[2 * h:] for p in planes]
            planes, T = [cat(si, ti) for si, ti in zip(s, tail)], h + 1
        else:
            planes, T = s, h
    return [None if p is None else p[0] for p in planes]


def lane_fold_torch(planes, width: int):
    """Plain torch version of :func:`lane_fold` (bool or int32 planes).

    The port of the reference's ``lane_fold_jnp`` tree.  Runs on any
    device; the dispatch gives it CPU tensors and bool planes, and
    ``chip_smoke.py`` holds the CUDA kernel against it on the card.
    """
    return _tree_fold(planes, width)


# ---------------------------------------------------------------------------
# CUDA kernel: the whole fold in one launch over packed words
# ---------------------------------------------------------------------------
@functools.cache
def _kernel():
    """The built ``lane_fold_launch`` C entry point (built on first use)."""
    fn = ctypes.CDLL(str(build.library("lane_fold"))).lane_fold_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lane_fold_cuda(x: torch.Tensor, width: int) -> torch.Tensor:
    """CUDA fold: ``x`` is ``(m, T, W)`` int32 words on a CUDA device
    with ``1 <= m <= width <= LANE_FOLD_MAX_WIDTH``; returns the
    ``(width, W)`` int32 planes of ``sum_t x[:, t] mod 2**width``.

    Launches ``csrc/lane_fold.cu`` on the current stream (no sync) and
    counts the launch in ``lane_fold_cuda.launches``.  Raises on any
    input the kernel does not take; it never computes on another path.
    """
    if x.device.type != "cuda":
        raise ValueError(f"lane_fold_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"lane_fold_cuda needs int32 words, got {x.dtype}")
    if x.ndim != 3 or not x.is_contiguous():
        raise ValueError(
            f"lane_fold_cuda needs a contiguous (m, T, W) tensor, got "
            f"shape {tuple(x.shape)} contiguous={x.is_contiguous()}")
    m, lanes, words = x.shape
    if not (1 <= m <= width <= LANE_FOLD_MAX_WIDTH) or lanes < 1 \
            or words < 1:
        raise ValueError(
            f"lane_fold_cuda: unsupported m={m} T={lanes} W={words} "
            f"width={width} (need 1 <= m <= width <= "
            f"{LANE_FOLD_MAX_WIDTH}, T, W >= 1)")
    fn = _kernel()
    out = torch.empty((width, words), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), out.data_ptr(), m, lanes, words, width,
                 stream)
    if err != 0:
        raise RuntimeError(f"lane_fold kernel launch failed: CUDA error {err}")
    lane_fold_cuda.launches += 1
    return out


lane_fold_cuda.launches = 0


# The kernel as an operator a traced graph can hold.  ``lane_fold_cuda``
# writes its output from C through raw pointers, which a tracer cannot
# see: a graph traced through it would keep only the ``torch.empty``
# and replay an uninitialised tensor.  Called through this op, a trace
# records one ``repro_torch::lane_fold`` node (its fake implementation
# gives the shape), and every call of the graph runs the op's body,
# which launches the kernel and counts the launch.  The body looks
# ``lane_fold_cuda`` up when it runs, so a stand-in for the kernel
# (the CPU rehearsals of the smoke's phases) serves graphs as well.
@torch.library.custom_op("repro_torch::lane_fold", mutates_args=())
def lane_fold_op(x: torch.Tensor, width: int) -> torch.Tensor:
    """``lane_fold_cuda(x, width)`` as the ``repro_torch::lane_fold``
    operator: launches the kernel on CUDA words, raises otherwise."""
    return lane_fold_cuda(x, width)


@lane_fold_op.register_fake
def _lane_fold_fake(x, width):
    return x.new_empty((width, x.shape[-1]), dtype=torch.int32)


def use_kernel_fold(device: torch.device, packed: bool) -> bool:
    """Selection rule: packed planes on a CUDA device run the kernel, at
    every size; CPU planes and bool (unpacked) planes run the tree."""
    return packed and torch.device(device).type == "cuda"


def lane_fold(planes, width: int, *, packed: bool):
    """Fold lane-shaped planes down the lane axis, mod ``2**width``.

    ``planes`` entries are ``(T, W)`` tensors or None (known zero); the
    result list may contain None entries likewise.  Dispatches per
    :func:`use_kernel_fold`; the kernel route calls the
    ``repro_torch::lane_fold`` operator.  The kernel gets the planes up
    to the last live one (it zero-extends the rest), so known-zero top
    planes are neither built nor read.
    """
    live = [i for i, p in enumerate(planes[:width]) if p is not None]
    if not live:
        return [None] * width
    first = planes[live[0]]
    if not use_kernel_fold(first.device, packed):
        return lane_fold_torch(planes, width)
    zero = None
    stacked = []
    for p in planes[:live[-1] + 1]:
        if p is None:
            zero = torch.zeros_like(first) if zero is None else zero
            p = zero
        stacked.append(p)
    out = torch.ops.repro_torch.lane_fold(torch.stack(stacked), width)
    return [out[i] for i in range(width)]
