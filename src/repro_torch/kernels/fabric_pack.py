"""The fabric's block images, packed on the device.

One launch of the fabric (``pim/fabric.py``, ``execute_program``) runs
the same ``idot`` program on ``slots`` blocks; block ``s`` holds the
bit planes of one task's activation and weight tiles in its ``rows x
cols`` image.  :func:`fabric_pack` writes that ``(slots, rows, cols)``
bool image from:

* ``x`` ``(M, K)`` and ``w`` ``(K, ntot)``: one dtype class's activation
  and weights (its GEMMs side by side along ``ntot``), uint8 for classes
  of at most 8 bits and int32 (32-bit words) for wider ones;
* ``desc`` ``(slots, 6)`` int32, a row per slot: ``m, k0, kw, col0, nw,
  used`` -- the task's activation row, its K-tile start and width, its
  first weight column in ``w`` and its N-tile width; ``used`` 0 marks a
  padded slot, which is all zero;
* ``rowmap`` ``(rows,)`` int32: each row's operand bit, as
  :func:`row_code` encodes it, or -1 for a row no operand bit lives in.

Image bit ``[s, r, c]`` is bit ``j`` of ``x[m, k0 + i]`` on a row of
field ``a`` (every column), bit ``j`` of ``w[k0 + i, col0 + c]`` for
``c < nw`` on a row of field ``b``, and 0 elsewhere and for tuples
``i >= kw``: the image ``pack_blocks`` builds on the host, bit for bit.

CUDA tensors launch the hand-written kernel (:func:`fabric_pack_cuda`,
``csrc/fabric_pack.cu``); CPU tensors run the plain torch version
(:func:`fabric_pack_torch`), which the tests and ``chip_smoke.py`` hold
the kernel to.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

__all__ = ["fabric_pack", "fabric_pack_torch", "fabric_pack_cuda",
           "row_code", "DESC_FIELDS", "ROW_FIELD_B", "ROW_TUPLE_SHIFT"]

#: int32 fields of a slot descriptor; FP_DESC in csrc/fabric_pack.cu
DESC_FIELDS = 6
#: row map code bit of field ``b``; FP_FIELD_B in csrc/fabric_pack.cu
ROW_FIELD_B = 1 << 8
#: row map code: the tuple sits above this bit; FP_TUPLE_SHIFT there
ROW_TUPLE_SHIFT = 9

_ELEM_BYTES = {torch.uint8: 1, torch.int32: 4}


def row_code(tuple_i: int, field: str, bit: int) -> int:
    """The row map code of bit ``bit`` of field ``field`` (``"a"`` or
    ``"b"``) of tuple ``tuple_i``."""
    if field not in ("a", "b") or not 0 <= bit < 32 or tuple_i < 0:
        raise ValueError(f"no row code for tuple {tuple_i}, field "
                         f"{field!r}, bit {bit}")
    return (tuple_i << ROW_TUPLE_SHIFT) \
        | (ROW_FIELD_B if field == "b" else 0) | bit


def _check(x, w, desc, rowmap, cols):
    if x.dtype not in _ELEM_BYTES or w.dtype != x.dtype:
        raise TypeError(f"fabric_pack needs uint8 or int32 operands of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    if desc.dtype != torch.int32 or rowmap.dtype != torch.int32:
        raise TypeError(f"fabric_pack needs an int32 descriptor and row "
                        f"map, got {desc.dtype} and {rowmap.dtype}")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0] \
            or desc.ndim != 2 or desc.shape[1] != DESC_FIELDS \
            or rowmap.ndim != 1 or cols < 1 or min(x.shape) < 1 \
            or min(w.shape) < 1 or desc.shape[0] < 1 or rowmap.shape[0] < 1:
        raise ValueError(
            f"fabric_pack needs x (M, K), w (K, N), desc (S, {DESC_FIELDS}), "
            f"rowmap (R,) and cols >= 1, got {tuple(x.shape)}, "
            f"{tuple(w.shape)}, {tuple(desc.shape)}, {tuple(rowmap.shape)}, "
            f"{cols}")
    if len({t.device for t in (x, w, desc, rowmap)}) != 1:
        raise ValueError("fabric_pack needs all its tensors on one device")


def fabric_pack(x: torch.Tensor, w: torch.Tensor, desc: torch.Tensor,
                rowmap: torch.Tensor, cols: int) -> torch.Tensor:
    """The ``(slots, rows, cols)`` bool block images (module docstring):
    the kernel for CUDA tensors, the plain torch version for CPU ones."""
    if x.device.type == "cuda":
        return fabric_pack_cuda(x, w, desc, rowmap, cols)
    return fabric_pack_torch(x, w, desc, rowmap, cols)


def fabric_pack_torch(x: torch.Tensor, w: torch.Tensor, desc: torch.Tensor,
                      rowmap: torch.Tensor, cols: int) -> torch.Tensor:
    """Plain torch version of the kernel: the same image from the same
    inputs, on any device.  Field ``a`` rows broadcast one activation
    bit over the columns; field ``b`` rows gather one weight bit per
    column."""
    _check(x, w, desc, rowmap, cols)
    dev = x.device
    slots, rows = desc.shape[0], rowmap.shape[0]
    m, k0, kw, col0, nw, used = desc.long().unbind(1)
    code = rowmap.long()
    out = torch.zeros((slots, rows, cols), dtype=torch.bool, device=dev)
    # 32-bit words are read as unsigned: keep their low 32 bits
    xv, wv = (t.long() & 0xFFFFFFFF for t in (x, w))
    col = torch.arange(cols, device=dev)
    for field_b in (False, True):
        r = torch.nonzero((code >= 0) & (((code & ROW_FIELD_B) != 0)
                                         == field_b)).flatten()
        if r.numel() == 0:
            continue
        i, bit = code[r] >> ROW_TUPLE_SHIFT, code[r] & 0xFF
        live = (used[:, None] != 0) & (i[None, :] < kw[:, None])  # (S, R')
        k = torch.where(live, k0[:, None] + i[None, :], 0)
        if field_b:
            in_tile = col[None, :] < nw[:, None]                  # (S, C)
            n = torch.where(in_tile, col0[:, None] + col[None, :], 0)
            v = wv[k[:, :, None], n[:, None, :]]                  # (S, R', C)
            on = ((v >> bit[None, :, None]) & 1 != 0) \
                & live[:, :, None] & in_tile[:, None, :]
        else:
            v = xv[m[:, None], k]                                 # (S, R')
            on = (((v >> bit[None, :]) & 1 != 0) & live)[:, :, None] \
                .expand(slots, r.numel(), cols)
        out[:, r, :] = on
    return out


@functools.cache
def _kernel():
    """The built ``fabric_pack_launch`` C entry point.  A launch that
    packs on the card folds through ``lane_fold`` next, so a checkout
    without either library compiles both at once."""
    build.build_all(("fabric_pack", "lane_fold"))
    fn = ctypes.CDLL(str(build.library("fabric_pack"))).fabric_pack_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fabric_pack_cuda(x: torch.Tensor, w: torch.Tensor, desc: torch.Tensor,
                     rowmap: torch.Tensor, cols: int) -> torch.Tensor:
    """The kernel: CUDA tensors, contiguous, as the module docstring
    gives them.  Launches ``csrc/fabric_pack.cu`` on the current stream
    (no sync) into a fresh ``torch.empty`` image, which it writes whole,
    and counts the launch in ``fabric_pack_cuda.launches``.  Raises on
    any input the kernel does not take; it never computes on another
    path."""
    if x.device.type != "cuda":
        raise ValueError(f"fabric_pack_cuda needs CUDA tensors, got "
                         f"{x.device}")
    _check(x, w, desc, rowmap, cols)
    if not all(t.is_contiguous() for t in (x, w, desc, rowmap)):
        raise ValueError("fabric_pack_cuda needs contiguous tensors")
    slots, rows = desc.shape[0], rowmap.shape[0]
    fn = _kernel()
    out = torch.empty((slots, rows, cols), dtype=torch.bool, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), desc.data_ptr(),
                 rowmap.data_ptr(), out.data_ptr(), slots, rows, cols,
                 x.shape[1], w.shape[1], _ELEM_BYTES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"fabric_pack kernel launch failed: CUDA error "
                           f"{err}")
    fabric_pack_cuda.launches += 1
    return out


fabric_pack_cuda.launches = 0
