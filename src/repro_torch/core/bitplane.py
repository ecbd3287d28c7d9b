"""Transposed bit-plane layout helpers (paper §II-B / Fig 2).

Bit-serial arithmetic stores operands *transposed*: the bits of one
operand live in one column across consecutive rows (LSB in the lowest
row).  These helpers convert between integer/bfloat16 vectors and the
``(rows, cols)`` boolean main array of the engine.

Convention: for an n-bit operand at row base ``r``, row ``r + i`` holds
bit ``i`` (LSB first).  bfloat16 uses its uint16 bit pattern, so rows
``r+0..r+6`` = mantissa, ``r+7..r+14`` = exponent, ``r+15`` = sign.
Unsigned values up to 32 bits are carried in ``torch.int64`` (torch's
``uint32`` lacks the shift operators).
"""

from __future__ import annotations

import numpy as np
import torch


def int_to_planes(x, nbits: int):
    """(cols,) unsigned ints -> (nbits, cols) bool planes, LSB first."""
    x = torch.as_tensor(x).to(torch.int64)
    shifts = torch.arange(nbits, dtype=torch.int64, device=x.device)[:, None]
    return ((x[None, :] >> shifts) & 1).to(torch.bool)


def planes_to_int(planes, dtype=torch.int64):
    """(nbits, cols) bool planes -> (cols,) unsigned ints."""
    planes = torch.as_tensor(planes)
    nbits = planes.shape[0]
    shifts = torch.arange(nbits, dtype=torch.int64, device=planes.device)
    weights = (torch.ones_like(shifts) << shifts)[:, None]
    return torch.sum(planes.to(torch.int64) * weights, dim=0).to(dtype)


def bf16_to_planes(x):
    """(cols,) bfloat16 -> (16, cols) bool planes of the bit pattern."""
    u = torch.as_tensor(x).to(torch.bfloat16).view(torch.int16)
    return int_to_planes(u.to(torch.int64) & 0xFFFF, 16)


def planes_to_bf16(planes):
    """(16, cols) bool planes -> (cols,) bfloat16."""
    u = planes_to_int(planes)
    # wrap the 16-bit pattern into int16 before reinterpreting it
    return (u - ((u >> 15) << 16)).to(torch.int16).view(torch.bfloat16)


def store(state_array, base: int, planes):
    """Rows [base, base+n) of the main array replaced by ``planes``
    (a new tensor; the input is unchanged)."""
    out = state_array.clone()
    out[base:base + planes.shape[0]] = planes
    return out


def load(state_array, base: int, nbits: int):
    """Read rows [base, base+nbits) as bit planes."""
    return state_array[base:base + nbits]


# numpy mirrors (test convenience) ------------------------------------------
def np_int_to_planes(x, nbits: int) -> np.ndarray:
    x = np.asarray(x, np.uint64)
    return ((x[None, :] >> np.arange(nbits, dtype=np.uint64)[:, None]) & 1
            ).astype(bool)


def np_planes_to_int(planes: np.ndarray) -> np.ndarray:
    nbits = planes.shape[0]
    w = (np.uint64(1) << np.arange(nbits, dtype=np.uint64))[:, None]
    return (planes.astype(np.uint64) * w).sum(axis=0)
