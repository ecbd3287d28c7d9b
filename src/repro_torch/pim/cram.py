"""Compute-RAM-backed matmul: run integer GEMMs on the engine itself.

The counterpart of ``repro.pim.cram``.  It maps a quantized matmul onto
the Compute RAM block simulator -- operands transposed into bit-serial
columns, one ``idot`` program per block, blocks batched with
``engine.execute_blocks`` on ``device`` (``None``: the GPU; there is no
silent CPU default).  Operands and results are numpy arrays; the blocks'
state lives on the device only while a program runs.

Mapping for ``cram_matmul(x, w)`` with x ``(M, K)`` and w ``(K, N)``
unsigned ints: output column ``n`` lives in CR column ``n`` (paper's
40-column block => N <= cols per block), K is the serial tuple axis,
and each output row m is one CR block (vmap axis).

Signed operands (``signed=True``) use the standard zero-point offset:
the ``idot`` program is unsigned-only hardware (the paper handles sign
"one level up" via bit-plane weighting), so signed values in
``[-2^(n-1), 2^(n-1))`` are biased by ``off = 2^(n-1)`` into unsigned
range, run exactly, and corrected on readback:

    x @ w = (u_x - off) @ (u_w - off)
          = u_x @ u_w - off*rowsum(u_x) - off*colsum(u_w) + K*off^2

The correction terms are host-side sums of values the host loaded into
storage mode anyway -- no extra block cycles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core import engine, floatprog, harness, programs


# ---------------------------------------------------------------------------
# Element dtypes the PIM stack schedules (per-GEMM asymmetric precision)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class DType:
    """One schedulable element type: integer or FTZ+RTZ float."""
    name: str
    kind: str                    # "int" | "float"
    bits: int                    # storage bits per element
    fmt: Optional[floatprog.FloatFormat] = None   # floats only

    @property
    def is_float(self) -> bool:
        return self.kind == "float"


DTYPES = {
    "int4": DType("int4", "int", 4),
    "int8": DType("int8", "int", 8),
    "int16": DType("int16", "int", 16),
    "bf16": DType("bf16", "float", 16, floatprog.BF16),
    "fp16": DType("fp16", "float", 16, floatprog.FP16),
    "fp8": DType("fp8", "float", 8, floatprog.FP8_E4M3),
}

#: numpy/torch dtype names -> DTYPES keys.
_DTYPE_ALIASES = {
    "bfloat16": "bf16", "float16": "fp16", "float8_e4m3fn": "fp8",
    "float8_e4m3": "fp8", "uint8": "int8", "uint16": "int16",
}


def resolve_dtype(dtype) -> Optional[DType]:
    """Map a dtype spec (DType | str | numpy/torch dtype) to a DType.

    ``None`` passes through (callers substitute their int default).
    Accepts ``torch.bfloat16`` / ``np.float16`` style dtype objects, the
    DTYPES keys, and numpy dtype names.
    """
    if dtype is None or isinstance(dtype, DType):
        return dtype
    if isinstance(dtype, str):
        key = dtype
    elif isinstance(dtype, torch.dtype):
        key = str(dtype).removeprefix("torch.")
    else:
        try:
            key = np.dtype(dtype).name
        except TypeError:
            key = getattr(dtype, "__name__", str(dtype))
    key = _DTYPE_ALIASES.get(key, key)
    if key not in DTYPES:
        raise ValueError(
            f"unsupported dtype {dtype!r}; expected one of "
            f"{sorted(DTYPES)} (or a numpy/torch dtype mapping to one)")
    return DTYPES[key]


def idot_geometry(n: int, rows: int = 512, acc_bits: int = 32):
    """Max dot-product length (tuples) an ``idot`` program supports."""
    _, lay = programs.idot(n, rows=rows, acc_bits=acc_bits)
    return lay.tuples


def idot_tile(n: int, rows: int = 512, acc_bits: int = 32) -> int:
    """K-tile for exact accumulation: :func:`idot_geometry` clamped so
    ``tuples * (2^n - 1)^2`` provably fits the accumulator (the wide
    precisions -- int16 -- would otherwise wrap mod ``2^acc_bits``)."""
    acc_limit = ((1 << acc_bits) - 1) // max((1 << n) - 1, 1) ** 2
    return max(1, min(idot_geometry(n, rows, acc_bits), acc_limit))


def _bias_signed(x, n: int):
    """Two's-complement -> biased-unsigned (``u = x + 2^(n-1)``)."""
    off = np.int64(1 << (n - 1))
    return (np.asarray(x, np.int64) + off).astype(np.uint64), off


def _unbias(raw, off, a_sums, b_sums, T: int) -> np.ndarray:
    """Invert the offset on a raw biased-unsigned accumulator:

        x @ w = u_x @ u_w - off*sum(u_x) - off*sum(u_w) + T*off^2

    ``a_sums`` / ``b_sums`` are the biased operands' reduction sums,
    already broadcast to ``raw``'s shape; ``T`` is the reduction length.
    Shared by cram_dot / cram_matmul / the fabric scheduler so the
    algebra can never diverge between layers.
    """
    corr = off * a_sums + off * b_sums - np.int64(T) * off * off
    return np.asarray(raw).astype(np.int64) - corr


def _check_range(arrs, n: int, signed: bool):
    if signed:
        lo, hi = -(1 << (n - 1)), 1 << (n - 1)
        for a in arrs:
            ai = np.asarray(a, np.int64)
            if np.any(ai < lo) or np.any(ai >= hi):
                raise ValueError(
                    f"signed operands must be in [{lo}, {hi})")
    else:
        for a in arrs:
            ai = np.asarray(a, np.int64)
            if np.any(ai < 0) or np.any(ai >= (1 << n)):
                raise ValueError(f"operands must be < 2^{n}")


def cram_dot(a, b, n: int, rows: int = 512,
             executor: str = "compiled", signed: bool = False,
             device=None) -> np.ndarray:
    """Per-column dot products on one Compute RAM block.

    a, b: ``(T, cols)`` ints (unsigned ``< 2^n``, or two's-complement
    signed with ``signed=True``).  Returns ``(cols,)`` ``sum_t
    a[t] * b[t]`` -- uint64 for unsigned, int64 for signed (exact).

    ``T`` may exceed one program's tuple capacity (partial-tile
    support): the dot is K-tiled over multiple program launches and
    accumulated host-side, mirroring how the fabric scheduler streams
    a long reduction through one block.
    """
    device = engine.resolve_device(device)
    _check_range((a, b), n, signed)
    if signed:
        au, off = _bias_signed(a, n)
        bu, _ = _bias_signed(b, n)
        raw = cram_dot(au, bu, n, rows=rows, executor=executor,
                       device=device)
        return _unbias(raw, off, au.sum(axis=0, dtype=np.int64),
                       bu.sum(axis=0, dtype=np.int64), a.shape[0])
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    kt = idot_tile(n, rows)
    out = np.zeros((a.shape[1],), np.uint64)
    for k0 in range(0, a.shape[0], kt):
        ksl = slice(k0, min(a.shape[0], k0 + kt))
        prog, lay = programs.idot(n, rows=rows, tuples=ksl.stop - k0)
        arr = harness.run_program(prog, lay, {"a": a[ksl], "b": b[ksl]},
                                  a.shape[1], executor=executor,
                                  device=device)
        out += harness.unpack_acc(arr, lay)
    return out


def fdot_geometry(fmt, rows: int = 512,
                  guard: int = floatprog.ACC_GUARD) -> int:
    """Max dot length (tuples) a ``float_dot`` program supports; 0 when
    the geometry cannot host the format's scratch + accumulator."""
    if isinstance(fmt, DType):
        fmt = fmt.fmt
    try:
        _, lay = floatprog.float_dot(fmt, rows=rows, guard=guard)
    except ValueError:
        return 0
    return lay.tuples


def _resolve_fmt(fmt) -> floatprog.FloatFormat:
    if isinstance(fmt, floatprog.FloatFormat):
        return fmt
    info = resolve_dtype(fmt)
    if info is None or info.fmt is None:
        raise ValueError(f"{fmt!r} is not a float dtype")
    return info.fmt


def cram_fdot(a_bits, b_bits, fmt, rows: int = 512,
              executor: str = "compiled",
              guard: int = floatprog.ACC_GUARD, device=None) -> np.ndarray:
    """Per-column float fused-MAC dot products on one Compute RAM block.

    a_bits, b_bits: ``(T, cols)`` fmt bit patterns (``ref.to_bits``).
    Returns ``(cols,)`` fmt bit patterns with the documented FTZ+RTZ
    fused-MAC semantics (:func:`core.ref.float_dot`).  ``T`` may
    exceed one program's tuple capacity: the reduction is K-tiled over
    multiple launches with the *wide accumulator image carried between
    them*, so the result is bit-identical to a single sequential pass
    regardless of tiling.
    """
    device = engine.resolve_device(device)
    fmt = _resolve_fmt(fmt)
    a = np.asarray(a_bits, np.uint64)
    b = np.asarray(b_bits, np.uint64)
    if np.any(a >= (1 << fmt.width)) or np.any(b >= (1 << fmt.width)):
        raise ValueError(f"operands must be {fmt.width}-bit patterns")
    kt = fdot_geometry(fmt, rows, guard)
    if kt < 1:
        raise ValueError(
            f"geometry {rows} rows cannot host a float_dot[{fmt.name}] "
            f"program (too few rows)")
    K = a.shape[0]
    res = np.zeros((a.shape[1],), np.uint64)     # empty reduction: +0
    acc = None
    cache = {}                                   # tuples -> (prog, lay)
    for k0 in range(0, K, kt):
        t = min(K, k0 + kt) - k0
        if t not in cache:
            cache[t] = floatprog.float_dot(fmt, rows=rows, tuples=t,
                                           guard=guard)
        prog, lay = cache[t]
        img = harness.pack_state(lay, {"a": a[k0:k0 + t], "b": b[k0:k0 + t]},
                                 a.shape[1])
        if acc is not None:
            floatprog.fdot_set_acc(img, fmt, acc, guard)
        arr = engine.run(prog, harness.make_torch_state(img, device),
                         executor=executor).array.cpu().numpy()
        acc = floatprog.fdot_acc(arr, fmt, guard)
        res = floatprog.fdot_result(arr, fmt)
    return res


def cram_fmatmul(x_bits, w_bits, fmt, rows: int = 512, cols: int = 40,
                 executor: str = "compiled",
                 guard: int = floatprog.ACC_GUARD, device=None) -> np.ndarray:
    """``(M, K) @ (K, N)`` float matmul on CR blocks (bit patterns).

    The float face of :func:`cram_matmul`: N tiles over block columns,
    K tiles over ``float_dot`` capacity with the accumulator image
    chained across launches, M runs as parallel blocks.  Bit-exact vs
    :func:`core.ref.float_matmul` for any operands -- the result
    does not depend on the tiling.
    """
    device = engine.resolve_device(device)
    fmt = _resolve_fmt(fmt)
    x = np.asarray(x_bits, np.uint64)
    w = np.asarray(w_bits, np.uint64)
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"shape mismatch {x.shape} @ {w.shape}")
    kt = fdot_geometry(fmt, rows, guard)
    if kt < 1:
        raise ValueError(
            f"geometry {rows} rows cannot host a float_dot[{fmt.name}] "
            f"program (too few rows)")
    out = np.zeros((M, N), np.uint64)
    # only two distinct programs exist: the full K-tile and the final
    # ragged one -- build each once, not per (N-tile, K-tile) pair
    cache = {}
    for n0 in range(0, N, cols):
        nsl = slice(n0, min(N, n0 + cols))
        c = nsl.stop - n0
        accs = None                       # (M, c) wide images, chained
        for k0 in range(0, K, kt):
            ksl = slice(k0, min(K, k0 + kt))
            t = ksl.stop - k0
            if t not in cache:
                cache[t] = floatprog.float_dot(fmt, rows=rows, tuples=t,
                                               guard=guard)
            prog, lay = cache[t]
            imgs = []
            for m in range(M):
                img = harness.pack_state(lay, {
                    "a": np.repeat(x[m, ksl][:, None], c, axis=1),
                    "b": w[ksl, nsl],
                }, c)
                if accs is not None:
                    floatprog.fdot_set_acc(img, fmt, accs[m], guard)
                imgs.append(img)
            res = _run_blocks(prog, np.stack(imgs), executor, device)
            accs = [floatprog.fdot_acc(res[m], fmt, guard)
                    for m in range(M)]
            out[:, nsl] = np.stack([floatprog.fdot_result(res[m], fmt)
                                    for m in range(M)])
    return out


def cram_matmul(x, w, n: int = 4, rows: int = 512, cols: int = 40,
                executor: str = "compiled",
                signed: bool = False, device=None) -> np.ndarray:
    """``(M, K) @ (K, N)`` integer matmul on CR blocks.

    Tiles N over the block's columns and K over idot tuple capacity
    (ragged/partial edge tiles supported); M runs as parallel blocks via
    :func:`engine.execute_blocks`.  All full tiles share ONE compiled
    idot program (same geometry), so the compile cost is paid once per
    (n, rows, K-tile) shape.

    ``signed=True`` accepts two's-complement operands in
    ``[-2^(n-1), 2^(n-1))`` and returns exact int64 (see module
    docstring for the offset algebra) -- this is what lets
    quantized weights run without manual re-biasing.
    """
    device = engine.resolve_device(device)
    _check_range((x, w), n, signed)
    if signed:
        xu, off = _bias_signed(x, n)
        wu, _ = _bias_signed(w, n)
        raw = cram_matmul(xu, wu, n=n, rows=rows, cols=cols,
                          executor=executor, device=device)
        return _unbias(raw, off,
                       xu.sum(axis=1, dtype=np.int64)[:, None],
                       wu.sum(axis=0, dtype=np.int64)[None, :],
                       xu.shape[1])

    x = np.asarray(x, np.uint64)
    w = np.asarray(w, np.uint64)
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(f"shape mismatch {x.shape} @ {w.shape}")

    kt = idot_tile(n, rows)
    out = np.zeros((M, N), np.uint64)
    for k0 in range(0, K, kt):
        ksl = slice(k0, min(K, k0 + kt))
        t = ksl.stop - k0
        prog, lay = programs.idot(n, rows=rows, tuples=t)
        for n0 in range(0, N, cols):
            nsl = slice(n0, min(N, n0 + cols))
            c = nsl.stop - n0
            # one block per output row: (M, rows, c) batched state
            arrs = harness.pack_states(lay, {
                "a": x[:, ksl, None],
                "b": w[ksl, nsl],
            }, c, M)
            res = _run_blocks(prog, arrs, executor, device,
                              keep_rows=lay.acc_bits)
            out[:, nsl] += harness.unpack_acc(res, lay)
    return out


def _run_blocks(prog, arrs: np.ndarray, executor: str, device,
                keep_rows=None) -> np.ndarray:
    """Run ``prog`` on the ``(blocks, rows, cols)`` images on ``device``
    (fresh latches: carry 0, tag 1) and return the final arrays as
    numpy, only their first ``keep_rows`` rows when given."""
    blocks, _, cols = arrs.shape
    states = engine.CRState(
        array=torch.from_numpy(arrs).to(device),
        carry=torch.zeros((blocks, cols), dtype=torch.bool, device=device),
        tag=torch.ones((blocks, cols), dtype=torch.bool, device=device))
    res = engine.execute_blocks(prog, states, executor=executor).array
    if keep_rows is not None:
        res = res[:, :keep_rows]
    return res.cpu().numpy()
