"""Host-side load/readback for Compute RAM layouts.

In a real deployment the FPGA-side state machine writes operands into the
block in storage mode (paper §III-B); here, numpy plays that role.  Data
is laid out transposed per :class:`programs.TupleLayout`.

:func:`run_program` is the one-call harness used by tests and examples:
pack operands, execute with a chosen executor (``unroll`` / ``scan`` /
``compiled``), and return the final main-array image.
"""

from __future__ import annotations

import numpy as np
import torch

from .programs import TupleLayout


def pack_state(layout: TupleLayout, data: dict, cols: int) -> np.ndarray:
    """Build the (rows, cols) bool main-array image.

    ``data[name]`` is a ``(tuples, cols)`` array of unsigned ints (or
    uint16 bf16 bit patterns) for each layout field being loaded.
    """
    for name, vals in data.items():
        shape = np.shape(vals)
        if shape != (layout.tuples, cols):
            raise ValueError(
                f"{name}: expected {(layout.tuples, cols)}, got {shape}")
    return pack_states(layout, data, cols, 1)[0]


def pack_states(layout: TupleLayout, data: dict, cols: int,
                blocks: int) -> np.ndarray:
    """:func:`pack_state` for ``blocks`` blocks at once: the
    ``(blocks, rows, cols)`` image batch.  ``data[name]`` broadcasts to
    ``(blocks, tuples, cols)``."""
    arr = np.zeros((blocks, layout.rows, cols), dtype=bool)
    bases = np.array([layout.base(t) for t in range(layout.tuples)])
    for name, vals in data.items():
        off, width = layout.fields[name]
        vals = np.broadcast_to(np.asarray(vals, np.uint64),
                               (blocks, layout.tuples, cols))
        for i in range(width):
            arr[:, bases + off + i, :] = ((vals >> np.uint64(i))
                                          & np.uint64(1)).astype(bool)
    return arr


def unpack_field(arr: np.ndarray, layout: TupleLayout, name: str) -> np.ndarray:
    """Read a layout field back as ``(tuples, cols)`` unsigned ints."""
    arr = np.asarray(arr)
    off, width = layout.fields[name]
    out = np.zeros((layout.tuples, arr.shape[1]), np.uint64)
    bases = np.array([layout.base(t) for t in range(layout.tuples)])
    for i in range(width):
        out |= arr[bases + off + i, :].astype(np.uint64) << np.uint64(i)
    return out


def unpack_acc(arr: np.ndarray, layout: TupleLayout) -> np.ndarray:
    """Read the dot-product accumulator: (cols,) unsigned ints, or
    (blocks, cols) from a (blocks, rows, cols) batch."""
    arr = np.asarray(arr)
    out = np.zeros(arr.shape[:-2] + arr.shape[-1:], np.uint64)
    for i in range(layout.acc_bits):
        out |= arr[..., i, :].astype(np.uint64) << np.uint64(i)
    return out


def make_torch_state(arr: np.ndarray, device=None):
    """Wrap a packed main-array image into a fresh CRState on ``device``
    (``None``: the GPU)."""
    from . import engine

    dev = engine.resolve_device(device)
    cols = arr.shape[1]
    return engine.CRState(
        torch.as_tensor(np.asarray(arr, dtype=bool), device=dev),
        torch.zeros((cols,), dtype=torch.bool, device=dev),
        torch.ones((cols,), dtype=torch.bool, device=dev))


def run_program(program, layout: TupleLayout, data: dict, cols: int,
                executor: str = "compiled", device=None) -> np.ndarray:
    """Pack ``data``, run ``program`` with ``executor`` on ``device``
    (``None``: the GPU), return the final array as numpy.

    The default ``compiled`` executor caches its lowered program per
    (program, geometry).
    """
    from . import engine

    state = make_torch_state(pack_state(layout, data, cols), device)
    return engine.run(program, state, executor=executor).array.cpu().numpy()
