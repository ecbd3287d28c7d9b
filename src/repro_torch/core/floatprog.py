"""Parameterized floating-point instruction sequences — the paper's
"any custom precision" claim (§III-C advantage 2), literally.

One generator pair covers every (exp_bits, man_bits) format: bfloat16
(8,7), IEEE half (5,10), fp8-e4m3 (4,3), or anything else — switching
precision is *loading a different instruction sequence*, no hardware
change.  Semantics: FTZ + RTZ, finite-only (same as the bf16 oracles;
generalized oracles live in ``repro.core.ref``).

Bit layout per operand (LSB-first rows): m mantissa, e exponent, 1 sign.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from .isa import (AddReg, Instr, Loop, Program, R, SetReg,
                  OP_C0, OP_C1, OP_COPY, OP_CSTORE, OP_FA, OP_FS, OP_NOT,
                  OP_T1, OP_TAND, OP_TC, OP_TNOT, OP_TNROW, OP_TOR,
                  OP_TROW, OP_TSTORE, OP_W0, OP_W1, OP_XOR)


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    ebits: int
    mbits: int
    name: str = ""

    @property
    def width(self) -> int:
        return 1 + self.ebits + self.mbits

    @property
    def bias(self) -> int:
        return (1 << (self.ebits - 1)) - 1

    @property
    def mm(self) -> int:                    # working mantissa reg width
        return self.mbits + 3

    @property
    def align_levels(self) -> int:          # shift bits for alignment
        return max(1, math.ceil(math.log2(self.mm)))

    @property
    def lz_shifts(self):                    # leading-zero normalize steps
        out = []
        k = 1
        while k <= self.mbits:
            out.append(k)
            k <<= 1
        return list(reversed(out))

    @property
    def sc_bits(self) -> int:
        return len(self.lz_shifts)


BF16 = FloatFormat(8, 7, "bf16")
FP16 = FloatFormat(5, 10, "fp16")
FP8_E4M3 = FloatFormat(4, 3, "fp8")


@dataclasses.dataclass(frozen=True)
class FloatScratch:
    """Absolute scratch-row map (sized per format)."""
    base: int
    fmt: FloatFormat

    def _sizes(self):
        f = self.fmt
        rr = max(f.mm, 2 * f.mbits + 2)
        return [("WA", f.width), ("WB", f.width), ("SW", 1), ("SBIG", 1),
                ("ED", f.ebits), ("MB", f.mm), ("MS", f.mm), ("RR", rr),
                ("EE", f.ebits + 1), ("MM", f.mbits), ("SC", f.sc_bits),
                ("CB", f.ebits + 1), ("HA", 1), ("HB", 1), ("SUB", 1),
                ("NEG", 1), ("COUT", 1), ("SGN", 1), ("UND", 1), ("Z", 1)]

    def __getattr__(self, name):
        off = object.__getattribute__(self, "base")
        for k, sz in object.__getattribute__(self, "_sizes")():
            if k == name:
                return off
            off += sz
        raise AttributeError(name)

    def size(self) -> int:
        return sum(sz for _, sz in self._sizes())


def _layout(fmt: FloatFormat, rows: int, tuples):
    from .programs import TupleLayout
    scratch = FloatScratch(0, fmt)
    scratch = FloatScratch(rows - scratch.size(), fmt)
    w = fmt.width
    stride = 3 * w
    T = tuples if tuples is not None else (rows - scratch.size()) // stride
    layout = TupleLayout(w, rows, stride, T,
                         {"a": (0, w), "b": (w, w), "d": (2 * w, w)},
                         scratch_base=scratch.base)
    return layout, scratch


def _ftz_hidden(e, s, fmt):
    """Extract hidden bits + flush subnormal inputs in WA/WB."""
    m, eb = fmt.mbits, fmt.ebits
    for W, H in ((s.WA, s.HA), (s.WB, s.HB)):
        e.tag_or(W + m, eb)
        e.op(OP_TSTORE, H)                  # hidden bit = (exp != 0)
        e.op(OP_TNOT)
        e.vec(OP_W0, W, count=m, pred=True)   # FTZ inputs


def _load_and_ftz(e, s, fmt):
    w = fmt.width
    e.vec_rel(OP_COPY, s.WA, 0, w, a_rel=True)
    e.vec_rel(OP_COPY, s.WB, w, w, a_rel=True)
    _ftz_hidden(e, s, fmt)


def float_add(fmt: FloatFormat, rows: int = 512,
              tuples=None) -> Tuple[Program, "TupleLayout"]:
    """d = a + b in the given format (FTZ, RTZ, finite-only)."""
    from .programs import _Emit
    layout, s = _layout(fmt, rows, tuples)
    m, eb, w = fmt.mbits, fmt.ebits, fmt.width

    e = _Emit()
    e.op(OP_W0, s.Z)
    e.op(OP_T1)
    e.ctrl(SetReg(4, 0))

    body = _Emit()
    body.op(OP_T1)
    _load_and_ftz(body, s, fmt)
    _add_core(body, s, fmt)

    # pack
    body.vec_rel(OP_COPY, 2 * w, s.RR, m, dst_rel=True)
    body.vec_rel(OP_COPY, 2 * w + m, s.EE, eb, dst_rel=True)
    body.nodes.append(Instr(OP_COPY, R(4, 2 * w + m + eb), s.SGN))
    body.nodes.append(AddReg(4, 3 * w))

    e.nodes.append(Loop(layout.tuples, body.nodes))
    return Program(f"{fmt.name or 'float'}_add x{layout.tuples}",
                   e.nodes), layout


def _add_core(body, s, fmt):
    """WA + WB -> (s.SGN, s.EE[:eb], s.RR[:m]), FTZ+RTZ.

    Everything of the float adder between operand load and result pack;
    shared verbatim by :func:`float_add` (operands = the tuple's a/b)
    and :func:`float_dot` (operands = running accumulator + product, in
    the widened accumulator format).  Expects WA/WB loaded and HA/HB
    set (:func:`_ftz_hidden`).
    """
    m, eb = fmt.mbits, fmt.ebits
    mm, L = fmt.mm, fmt.align_levels

    # swap flag + |ediff| + big/small register build (two predicated passes)
    body.op(OP_C0)
    body.vec(OP_FS, s.ED, s.WB + m, s.WA + m, count=eb, sa=1, sb=1)
    body.op(OP_TC)
    body.op(OP_TSTORE, s.SW)               # 1 -> BIG = WA
    body.op(OP_C0)
    body.vec(OP_FS, s.ED, s.Z, s.ED, count=eb, sa=0, sb=1, pred=True)

    for tagop, WBIG, WSML, HBIG, HSML in (
            (OP_TROW, s.WA, s.WB, s.HA, s.HB),
            (OP_TNROW, s.WB, s.WA, s.HB, s.HA)):
        body.op(tagop, a=s.SW)
        body.vec(OP_COPY, s.EE, WBIG + m, count=eb, pred=True)
        body.vec(OP_COPY, s.MB, WBIG, count=m, pred=True)
        body.op(OP_COPY, s.MB + m, HBIG, pred=True)
        body.vec(OP_COPY, s.MS, WSML, count=m, pred=True)
        body.op(OP_COPY, s.MS + m, HSML, pred=True)
        body.op(OP_COPY, s.SBIG, WBIG + m + eb, pred=True)
    body.op(OP_T1)
    for M in (s.MB, s.MS):
        body.op(OP_W0, M + m + 1)
        body.op(OP_W0, M + m + 2)

    # align: saturating right shift of MS by |ediff|
    if eb > L:
        body.tag_or(s.ED + L, eb - L)       # ediff >= 2^L -> zero
        body.vec(OP_W0, s.MS, count=mm, pred=True)
    for bit in range(L - 1, -1, -1):
        k = 1 << bit
        body.op(OP_TROW, a=s.ED + bit)
        keep = mm - k
        if keep > 0:
            body.vec(OP_COPY, s.MS, s.MS + k, count=keep, pred=True)
            body.vec(OP_W0, s.MS + keep, count=k, pred=True)
        else:
            body.vec(OP_W0, s.MS, count=mm, pred=True)

    # effective add/sub
    body.op(OP_XOR, s.SUB, s.WA + m + eb, s.WB + m + eb)
    body.op(OP_TROW, a=s.SUB)
    body.op(OP_C0)
    body.vec(OP_FS, s.RR, s.MB, s.MS, count=mm, sa=1, sb=1, pred=True)
    body.op(OP_CSTORE, s.COUT, pred=True)
    body.op(OP_TNROW, a=s.SUB)
    body.op(OP_C0)
    body.vec(OP_FA, s.RR, s.MB, s.MS, count=mm, sa=1, sb=1, pred=True)
    body.op(OP_T1)

    # negative subtraction result
    body.op(OP_TROW, a=s.SUB)
    body.op(OP_TAND, a=s.COUT)
    body.op(OP_TSTORE, s.NEG)
    body.op(OP_C0)
    body.vec(OP_FS, s.RR, s.Z, s.RR, count=mm, sa=0, sb=1, pred=True)
    body.op(OP_XOR, s.SGN, s.SBIG, s.NEG)
    body.op(OP_T1)

    # add-overflow normalize: bit m+1
    body.op(OP_TNROW, a=s.SUB)
    body.op(OP_TAND, a=s.RR + m + 1)
    body.vec(OP_COPY, s.RR, s.RR + 1, count=m + 1, pred=True)
    body.op(OP_W0, s.RR + m + 1, pred=True)
    body.op(OP_C1)
    body.vec(OP_FA, s.EE, s.EE, s.Z, count=eb, sa=1, sb=0, pred=True)
    body.op(OP_T1)
    body.op(OP_C0)

    # leading-zero normalize with shift-count accumulation
    body.vec(OP_W0, s.SC, count=fmt.sc_bits)
    for k in fmt.lz_shifts:
        if k > 1:
            body.tag_or(s.RR + m - k + 1, k, invert=True)
        else:
            body.op(OP_TNROW, a=s.RR + m)
        body.op(OP_TSTORE, s.SC + int(math.log2(k)))
        # left-shift by k: descending copy (loop-compressed)
        body.vec(OP_COPY, s.RR + m, s.RR + m - k, count=m - k + 1,
                 sd=-1, sa=-1, pred=True)
        body.vec(OP_W0, s.RR, count=k, pred=True)
    body.op(OP_T1)

    # EE -= SC
    body.op(OP_C0)
    scw = min(fmt.sc_bits, eb)
    body.vec(OP_FS, s.EE, s.EE, s.SC, count=scw, sa=1, sb=1)
    if eb > scw:
        body.vec(OP_FS, s.EE + scw, s.EE + scw, s.Z, count=eb - scw,
                 sa=1, sb=0)
    body.op(OP_CSTORE, s.UND)

    # flush: zero mantissa / underflow / exp==0
    body.tag_or(s.RR, mm, invert=True)
    body.op(OP_TSTORE, s.COUT)
    body.tag_or(s.EE, eb, invert=True)
    body.op(OP_TOR, a=s.COUT)
    body.op(OP_TOR, a=s.UND)
    body.vec(OP_W0, s.EE, count=eb, pred=True)
    body.vec(OP_W0, s.RR, count=m + 1, pred=True)
    body.op(OP_W0, s.SGN, pred=True)
    body.op(OP_T1)


def _mul_bias(e, s, fmt):
    """Write the exponent bias constant 2^(e-1) - 1 into s.CB."""
    eb = fmt.ebits
    for i in range(eb - 1):
        e.op(OP_W1, s.CB + i)
    e.op(OP_W0, s.CB + eb - 1)
    e.op(OP_W0, s.CB + eb)


def float_mul(fmt: FloatFormat, rows: int = 512,
              tuples=None) -> Tuple[Program, "TupleLayout"]:
    """d = a * b (FTZ, RTZ, finite-only, overflow wraps)."""
    from .programs import _Emit
    layout, s = _layout(fmt, rows, tuples)
    m, eb, w = fmt.mbits, fmt.ebits, fmt.width

    e = _Emit()
    e.op(OP_W0, s.Z)
    e.op(OP_T1)
    _mul_bias(e, s, fmt)
    e.ctrl(SetReg(4, 0))

    body = _Emit()
    body.op(OP_T1)
    _load_and_ftz(body, s, fmt)
    _mul_core(body, s, fmt)

    # pack
    body.vec_rel(OP_COPY, 2 * w, s.MM, m, dst_rel=True)
    body.vec_rel(OP_COPY, 2 * w + m, s.EE, eb, dst_rel=True)
    body.nodes.append(Instr(OP_COPY, R(4, 2 * w + m + eb), s.SGN))
    body.nodes.append(AddReg(4, 3 * w))

    e.nodes.append(Loop(layout.tuples, body.nodes))
    return Program(f"{fmt.name or 'float'}_mul x{layout.tuples}",
                   e.nodes), layout


def _mul_core(body, s, fmt):
    """WA * WB -> (s.SGN, s.EE[:eb] flushed, s.MM[:m]), FTZ+RTZ.

    The float multiplier between operand load and result pack, shared
    by :func:`float_mul` and the fused-MAC :func:`float_dot`.  Expects
    WA/WB loaded, HA/HB set, and the bias constant in s.CB
    (:func:`_mul_bias`, emitted once in the prelude).
    """
    m, eb = fmt.mbits, fmt.ebits

    body.op(OP_XOR, s.SGN, s.WA + m + eb, s.WB + m + eb)

    # exponent: EE = ea + eb - bias
    body.op(OP_C0)
    body.vec(OP_FA, s.EE, s.WA + m, s.WB + m, count=eb, sa=1, sb=1)
    body.op(OP_CSTORE, s.EE + eb)
    body.op(OP_C0)
    body.vec(OP_FS, s.EE, s.EE, s.CB, count=eb + 1, sa=1, sb=1)
    body.op(OP_CSTORE, s.UND)

    # hidden bits into position m (over exp LSB row, already consumed)
    body.op(OP_COPY, s.WA + m, s.HA)
    body.op(OP_COPY, s.WB + m, s.HB)

    # (m+1) x (m+1) -> 2m+2 bit product
    pw = 2 * m + 2
    body.vec(OP_W0, s.RR, count=pw)
    for i in range(m + 1):
        body.op(OP_TROW, a=s.WB + i)
        body.op(OP_C0)
        body.vec(OP_FA, s.RR + i, s.RR + i, s.WA, count=m + 1, sa=1, sb=1,
                 pred=True)
        body.op(OP_CSTORE, s.RR + i + m + 1, pred=True)
    body.op(OP_T1)

    # normalize: top bit 2m+1 set -> MM = RR[m+1 .. 2m], EE += 1
    body.op(OP_TROW, a=s.RR + 2 * m + 1)
    body.vec(OP_COPY, s.MM, s.RR + m + 1, count=m, pred=True)
    body.op(OP_C1)
    body.vec(OP_FA, s.EE, s.EE, s.Z, count=eb + 1, sa=1, sb=0, pred=True)
    body.op(OP_TNROW, a=s.RR + 2 * m + 1)
    body.vec(OP_COPY, s.MM, s.RR + m, count=m, pred=True)
    body.op(OP_T1)

    # flush: underflow / zero input / packed exp == 0
    body.op(OP_NOT, s.COUT, s.HA)
    body.op(OP_NOT, s.NEG, s.HB)
    body.op(OP_TROW, a=s.UND)
    body.op(OP_TOR, a=s.COUT)
    body.op(OP_TOR, a=s.NEG)
    body.op(OP_TSTORE, s.SUB)
    body.tag_or(s.EE, eb, invert=True)
    body.op(OP_TOR, a=s.SUB)
    body.vec(OP_W0, s.MM, count=m, pred=True)
    body.vec(OP_W0, s.EE, count=eb + 1, pred=True)
    body.op(OP_W0, s.SGN, pred=True)
    body.op(OP_T1)


# ---------------------------------------------------------------------------
# Fused multiply-accumulate: the paper's dot-product column at float
# precision.  acc rows hold a running accumulator in a *widened* format
# (same exponent field, mantissa + ACC_GUARD extra RTZ guard bits); each
# tuple multiplies exactly as float_mul, widens the product, and runs
# the float_add pipeline against the accumulator -- align, add/sub,
# normalize -- all in the wide format.  The final normalize/round (RTZ
# truncation of the guard bits + exp==0 flush) packs the result rows.
# ---------------------------------------------------------------------------
#: Extra low-order accumulator mantissa bits (the widened-accumulator
#: guard).  Matches repro.core.ref.ACC_GUARD -- the numpy oracle.
ACC_GUARD = 8


def wide_format(fmt: FloatFormat, guard: int = ACC_GUARD) -> FloatFormat:
    """The widened accumulator format of :func:`float_dot`."""
    return FloatFormat(fmt.ebits, fmt.mbits + guard,
                       f"{fmt.name}w" if fmt.name else "")


def float_dot(fmt: FloatFormat, rows: int = 512, tuples=None,
              guard: int = ACC_GUARD) -> Tuple[Program, "TupleLayout"]:
    """acc += sum_t a_t * b_t, FTZ + RTZ, widened accumulator.

    Layout: result rows ``[0, w)`` (fmt bit pattern, valid after every
    pass), accumulator rows ``[w, w + wide.width)`` (wide-format bit
    pattern: mantissa, exponent, sign -- host-initialized, so a fresh
    run starts from +0 and a K-tiled reduction *chains* by carrying the
    acc image between launches), tuples of ``{a, b}`` above.  Semantics
    (bit-exact oracle: :func:`repro.core.ref.float_dot`): per tuple the
    product is rounded to fmt exactly as :func:`float_mul`, widened by
    ``guard`` zero guard bits, and added to the accumulator with the
    :func:`float_add` pipeline at the wide format; the final
    normalize/round truncates the guard bits (RTZ) and flushes a zero
    exponent.
    """
    from .programs import TupleLayout, _Emit
    m, eb, w = fmt.mbits, fmt.ebits, fmt.width
    wide = wide_format(fmt, guard)
    mw = wide.mbits
    acc_w = wide.width                       # mantissa + exponent + sign
    ACC = w                                  # result at [0, w), acc above

    sw_base = rows - FloatScratch(0, wide).size()
    s_base = sw_base - FloatScratch(0, fmt).size()
    s = FloatScratch(s_base, fmt)
    sw = FloatScratch(sw_base, wide)
    stride = 2 * w
    tuple_base = w + acc_w
    cap = (s_base - tuple_base) // stride
    T = tuples if tuples is not None else cap
    if T < 1 or T > cap:
        raise ValueError(
            f"geometry {rows} rows cannot host float_dot[{fmt.name}] "
            f"with {T if tuples is not None else 1} tuple(s) "
            f"(capacity {max(cap, 0)})")
    layout = TupleLayout(w, rows, stride, T, {"a": (0, w), "b": (w, w)},
                         acc_bits=tuple_base, scratch_base=s_base,
                         tuple_base=tuple_base)

    e = _Emit()
    e.op(OP_W0, s.Z)
    e.op(OP_W0, sw.Z)
    e.op(OP_T1)
    _mul_bias(e, s, fmt)
    e.ctrl(SetReg(4, tuple_base))

    body = _Emit()
    body.op(OP_T1)
    _load_and_ftz(body, s, fmt)
    _mul_core(body, s, fmt)
    # widen the product into a wide-format operand (guard zeros low)
    body.vec(OP_W0, sw.WA, count=guard)
    body.vec(OP_COPY, sw.WA + guard, s.MM, count=m)
    body.vec(OP_COPY, sw.WA + mw, s.EE, count=eb)
    body.op(OP_COPY, sw.WA + mw + eb, s.SGN)
    # fetch the running accumulator (the loop-carried rows: everything
    # from here on is the serial suffix of the lane plan)
    body.vec(OP_COPY, sw.WB, ACC, count=acc_w)
    _ftz_hidden(body, sw, wide)
    _add_core(body, sw, wide)
    # write the accumulator back
    body.vec(OP_COPY, ACC, sw.RR, count=mw)
    body.vec(OP_COPY, ACC + mw, sw.EE, count=eb)
    body.op(OP_COPY, ACC + mw + eb, sw.SGN)
    body.ctrl(AddReg(4, stride))
    e.nodes.append(Loop(T, body.nodes))

    # final normalize/round: RTZ-drop the guard bits into the result
    e.vec(OP_COPY, 0, ACC + guard, count=m)
    e.vec(OP_COPY, m, ACC + mw, count=eb)
    e.op(OP_COPY, m + eb, ACC + mw + eb)
    e.tag_or(ACC + mw, eb, invert=True)
    e.vec(OP_W0, 0, count=w, pred=True)      # exp == 0 -> flush to +0
    e.op(OP_T1)
    return Program(f"{fmt.name or 'float'}_dot x{T}", e.nodes), layout


def _read_rows(arr, base: int, width: int):
    import numpy as np
    out = np.zeros((arr.shape[1],), np.uint64)
    for i in range(width):
        out |= arr[base + i, :].astype(np.uint64) << np.uint64(i)
    return out


def fdot_result(arr, fmt: FloatFormat):
    """Read the packed fmt result of a float_dot pass: (cols,) bits."""
    return _read_rows(arr, 0, fmt.width)


def fdot_acc(arr, fmt: FloatFormat, guard: int = ACC_GUARD):
    """Read the wide-format accumulator image: (cols,) bits."""
    return _read_rows(arr, fmt.width, wide_format(fmt, guard).width)


def fdot_set_acc(arr, fmt: FloatFormat, acc_bits,
                 guard: int = ACC_GUARD) -> None:
    """Write a wide-format accumulator image into a packed state array
    (in place) -- how a K-tiled reduction chains across launches."""
    import numpy as np
    acc_bits = np.asarray(acc_bits, np.uint64)
    w = fmt.width
    for i in range(wide_format(fmt, guard).width):
        arr[w + i, :] = ((acc_bits >> np.uint64(i)) & np.uint64(1)) \
            .astype(arr.dtype)
