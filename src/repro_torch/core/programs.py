"""Instruction-sequence generators for Compute RAM operations.

These are the "libraries of common operation sequences" the paper (§III-C)
anticipates shipping with Compute RAM-equipped FPGAs: given a precision
and an array geometry, each generator emits a :class:`~repro.core.isa.Program`
that processes **every column in parallel** and **T tuples per column
serially** (bit-serial arithmetic, transposed layout).

Layouts
-------
Each generator returns ``(program, layout)``.  The layout tells the host
(or :mod:`repro.core.bitplane`) where operands/results live:

* ``iadd``/``isub``: tuple ``t`` occupies rows ``[t*3n, (t+1)*3n)`` as
  ``{a: n, b: n, d: n}`` (the paper's packing: int4 -> 12 bits/tuple,
  3 tuples per 40-bit BRAM row when untransposed).
* ``imul``: stride ``4n``: ``{a: n, b: n, d: 2n}``.
* ``idot``: int32 accumulator in rows ``[0, acc_bits)``; tuple ``t`` at
  ``acc_bits + t*2n`` as ``{a: n, b: n}``; result = sum_t a_t*b_t.
* bf16 ops: stride 48 (a, b, d as 16-bit patterns), scratch block at the
  top of the array.

All integer programs are unsigned (two's-complement addition behaves
identically; signed multiply is handled one level up by bit-plane
weighting -- see ``repro.pim``).  bfloat16 programs implement
**FTZ (flush-to-zero subnormals) + RTZ (truncate) finite-only** semantics;
the matching oracle lives in ``repro.core.ref`` and tests validate
bit-exactness against it.

Register conventions: r4 = tuple base pointer; r1..r3, r5..r7 scratch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

from .isa import (AddReg, Instr, Loop, MovReg, Program, R, SetReg,
                  OP_AND, OP_C0, OP_C1, OP_COPY, OP_CROW, OP_CSTORE, OP_FA,
                  OP_FS, OP_NOR, OP_NOT, OP_OR, OP_T1, OP_TAND, OP_TC,
                  OP_TNC, OP_TNOT, OP_TNROW, OP_TOR, OP_TROW, OP_TSTORE,
                  OP_W0, OP_W1, OP_XOR)

DEFAULT_ROWS = 512
DEFAULT_COLS = 40


# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TupleLayout:
    """T tuples per column; field offsets are relative to tuple base."""
    nbits: int
    rows: int
    stride: int
    tuples: int
    fields: dict            # name -> (offset, width)
    acc_bits: int = 0       # for dot product: accumulator rows [0, acc_bits)
    scratch_base: int = 0   # first scratch row (0 = none)
    tuple_base: int = -1    # first tuple row (-1 => acc_bits)

    def base(self, t: int) -> int:
        off = self.tuple_base if self.tuple_base >= 0 else self.acc_bits
        return off + t * self.stride

    def row(self, t: int, field: str) -> int:
        off, _ = self.fields[field]
        return self.base(t) + off


def _tuples_for(rows: int, stride: int, reserved_top: int,
                reserved_bottom: int = 0) -> int:
    return (rows - reserved_top - reserved_bottom) // stride


# ---------------------------------------------------------------------------
# Integer add / sub:  d = a +/- b   (n-bit, wrapping; paper Fig 4)
# per-tuple steady state: 1 (carry clear) + n (full adds) cycles
# ---------------------------------------------------------------------------
def iadd(n: int, rows: int = DEFAULT_ROWS, sub: bool = False,
         tuples: int | None = None) -> Tuple[Program, TupleLayout]:
    stride = 3 * n
    T = tuples if tuples is not None else _tuples_for(rows, stride, 1)
    op = OP_FS if sub else OP_FA
    nodes = [
        SetReg(4, -2 * n),
        Loop(T, [
            Instr(OP_C0, inc=((4, 2 * n),)),
            Loop(n, [Instr(op, R(4, 2 * n), R(4, 0), R(4, n),
                           inc=((4, 1),))]),
        ]),
    ]
    layout = TupleLayout(n, rows, stride, T,
                         {"a": (0, n), "b": (n, n), "d": (2 * n, n)})
    return Program(f"{'isub' if sub else 'iadd'}{n}x{T}", nodes), layout


def isub(n: int, rows: int = DEFAULT_ROWS,
         tuples: int | None = None) -> Tuple[Program, TupleLayout]:
    return iadd(n, rows, sub=True, tuples=tuples)


# ---------------------------------------------------------------------------
# Integer multiply:  d(2n bits) = a * b  (unsigned shift-and-add)
# ---------------------------------------------------------------------------
def _mul_body(n: int, prod_nodes_abs: int | None = None) -> List:
    """Shift-and-add multiply of one tuple: d(2n) = a(n) * b(n).

    Assumes r4 = tuple base (a at +0, b at +n); product rows are either
    tuple-relative at +2n or absolute at ``prod_nodes_abs``.

    No explicit zeroing is needed: iteration 0 writes rows d..d+n-1
    directly as AND partial products, the carry-out of iteration i is
    CSTOREd into row d+i+n *before* iteration i+1 ever reads it, and no
    row above d+i+n is read at iteration i.  This is the optimized
    sequence recorded in EXPERIMENTS.md (program-level perf iteration).
    """
    if prod_nodes_abs is None:
        set_prod = MovReg(6, 4, 2 * n)
    else:
        set_prod = SetReg(6, prod_nodes_abs)
    return [
        MovReg(5, 4, n),          # r5 = multiplier-bit ptr
        set_prod,                 # r6 = product row ptr
        MovReg(7, 4, 0),          # r7 = multiplicand ptr
        # i = 0: direct AND partial products (no zeroing, no carry)
        Loop(n, [Instr(OP_AND, R(6), R(7), R(5),
                       inc=((6, 1), (7, 1)))]),
        # zero row d+n (read as top operand at i = 1); rewind pointers
        Instr(OP_W0, R(6), inc=((6, 1 - n), (7, -n), (5, 1))),
        # i = 1 .. n-1.  The CSTORE is *unpredicated*: where the
        # multiplier bit is 0, the (unpredicated) C0 left carry = 0, so
        # storing it both writes the correct 0 carry-out and scrubs any
        # stale value when product rows are reused across tuples (idot).
        Loop(n - 1, [
            Instr(OP_TROW, a=R(5), inc=((5, 1),)),
            Instr(OP_C0),
            Loop(n, [Instr(OP_FA, R(6), R(6), R(7), pred=True,
                           inc=((6, 1), (7, 1)))]),
            Instr(OP_CSTORE, R(6), inc=((6, 1 - n), (7, -n))),
        ]),
    ]


def imul(n: int, rows: int = DEFAULT_ROWS,
         tuples: int | None = None) -> Tuple[Program, TupleLayout]:
    stride = 4 * n
    T = tuples if tuples is not None else _tuples_for(rows, stride, 1)
    tuple_body = _mul_body(n) + [AddReg(4, stride)]
    nodes = [SetReg(4, 0), Loop(T, tuple_body)]
    layout = TupleLayout(n, rows, stride, T,
                         {"a": (0, n), "b": (n, n), "d": (2 * n, 2 * n)})
    return Program(f"imul{n}x{T}", nodes), layout


# ---------------------------------------------------------------------------
# Dot product: acc(32) = sum_t a_t * b_t  (paper Fig 6; int4 + int32 acc)
#
# Fused multiply-accumulate directly into the accumulator.  After the
# n partial-product adds at bit position i, the carry must ripple upward;
# the ripple span is bounded because after t tuples acc < t * (2^n - 1)^2,
# so bits >= 2n + ceil(log2(t)) are provably zero.  We use the worst-case
# (final-tuple) bound as a fixed hardware-loop trip count.
# ---------------------------------------------------------------------------
def idot(n: int, rows: int = DEFAULT_ROWS, acc_bits: int = 32,
         tuples: int | None = None) -> Tuple[Program, TupleLayout]:
    stride = 2 * n
    zero_row = rows - 1
    prod = acc_bits                               # 2n scratch product rows
    T = tuples if tuples is not None else \
        _tuples_for(rows, stride, 1 + 2 * n, acc_bits)
    # acc < T * (2^n - 1)^2  =>  bits >= 2n + ceil(log2 T) provably zero;
    # carry ripple after the product add never needs to pass `top`.
    top = min(acc_bits, 2 * n + max(1, T).bit_length() + 1)

    tuple_body: List = _mul_body(n, prod_nodes_abs=prod) + [
        # acc += product (2n bits), then bounded carry ripple to `top`
        Instr(OP_C0),
        SetReg(6, 0),
        SetReg(7, prod),
        Loop(2 * n, [Instr(OP_FA, R(6), R(6), R(7),
                           inc=((6, 1), (7, 1)))]),
        Loop(top - 2 * n, [Instr(OP_FA, R(6), R(6), zero_row,
                                 inc=((6, 1),))]),
        AddReg(4, stride),
    ]

    nodes = [
        SetReg(6, 0),
        Loop(acc_bits, [Instr(OP_W0, R(6), inc=((6, 1),))]),   # zero acc
        Instr(OP_W0, zero_row),
        Instr(OP_T1),
        SetReg(4, acc_bits + 2 * n),
        Loop(T, tuple_body),
    ]
    layout = TupleLayout(n, rows, stride, T,
                         {"a": (0, n), "b": (n, n)},
                         acc_bits=acc_bits, tuple_base=acc_bits + 2 * n)
    return Program(f"idot{n}x{T}", nodes), layout


# ===========================================================================
# bfloat16 (FTZ + RTZ, finite-only)
# ===========================================================================
# Operand bit pattern (LSB-first rows): m[0:7], e[7:15], s[15].
#
# Scratch block (absolute rows at the top of the array); per-program setup
# cost is amortized over the tuples in the column.

_BF = 16


class _Emit:
    """Helper for emitting bf16 programs with loop-compressed blocks."""

    def __init__(self):
        self.nodes: List = []

    # raw ops --------------------------------------------------------------
    def op(self, *a, **k):
        self.nodes.append(Instr(*a, **k))

    def ctrl(self, nd):
        self.nodes.append(nd)

    # vector op over `count` rows with per-operand strides ------------------
    def vec(self, op, dst, a=0, b=0, count=1, sd=1, sa=1, sb=0, pred=False):
        """for i in count: op(dst+i*sd, a+i*sa, b+i*sb) -- loop-compressed.

        Registers are only allocated for operands the opcode actually
        uses *and* that walk (stride != 0) -- keeps the instruction-memory
        footprint small (imem is only 256 slots).
        """
        from .isa import _READS_A, _READS_B, _WRITES_ROW
        use = {"d": op in _WRITES_ROW, "a": op in _READS_A,
               "b": op in _READS_B}
        if count <= 3:
            for i in range(count):
                self.op(op, dst + i * sd, a + i * sa, b + i * sb, pred=pred)
            return
        refs, inc = {}, []
        for name, reg, base, stride in (("d", 1, dst, sd), ("a", 2, a, sa),
                                        ("b", 3, b, sb)):
            if use[name] and stride:
                self.ctrl(SetReg(reg, base))
                refs[name] = R(reg)
                inc.append((reg, stride))
            else:
                refs[name] = base if use[name] else 0
        self.nodes.append(Loop(count, [
            Instr(op, refs["d"], refs["a"], refs["b"], pred=pred,
                  inc=tuple(inc))]))

    def vec_rel(self, op, dst, a, count, dst_rel=False, a_rel=False,
                pred=False):
        """vector copy where one side is tuple-relative (base reg 4)."""
        d = R(1)
        s = R(2)
        self.ctrl(MovReg(1, 4, dst) if dst_rel else SetReg(1, dst))
        self.ctrl(MovReg(2, 4, a) if a_rel else SetReg(2, a))
        self.nodes.append(Loop(count, [
            Instr(op, d, s, pred=pred, inc=((1, 1), (2, 1)))]))

    # tag = OR of rows [base, base+count) -----------------------------------
    def tag_or(self, base, count, invert=False):
        self.op(OP_TROW, a=base)
        if count > 1:
            self.ctrl(SetReg(2, base + 1))
            self.nodes.append(Loop(count - 1, [
                Instr(OP_TOR, a=R(2), inc=((2, 1),))]))
        if invert:
            self.op(OP_TNOT)


def bf16_add(rows: int = DEFAULT_ROWS,
             tuples: int | None = None):
    """d = a + b in bfloat16 (delegates to the parameterized generator)."""
    from .floatprog import BF16, float_add
    return float_add(BF16, rows=rows, tuples=tuples)


def bf16_mul(rows: int = DEFAULT_ROWS,
             tuples: int | None = None):
    """d = a * b in bfloat16 (delegates to the parameterized generator)."""
    from .floatprog import BF16, float_mul
    return float_mul(BF16, rows=rows, tuples=tuples)


def fp16_add(rows: int = DEFAULT_ROWS, tuples: int | None = None):
    from .floatprog import FP16, float_add
    return float_add(FP16, rows=rows, tuples=tuples)


def fp16_mul(rows: int = DEFAULT_ROWS, tuples: int | None = None):
    from .floatprog import FP16, float_mul
    return float_mul(FP16, rows=rows, tuples=tuples)


def fp8_add(rows: int = DEFAULT_ROWS, tuples: int | None = None):
    from .floatprog import FP8_E4M3, float_add
    return float_add(FP8_E4M3, rows=rows, tuples=tuples)


def fp8_mul(rows: int = DEFAULT_ROWS, tuples: int | None = None):
    from .floatprog import FP8_E4M3, float_mul
    return float_mul(FP8_E4M3, rows=rows, tuples=tuples)


def bf16_dot(rows: int = DEFAULT_ROWS, tuples: int | None = None):
    """Fused MAC: acc += sum_t a_t * b_t in bfloat16 (see floatprog)."""
    from .floatprog import BF16, float_dot
    return float_dot(BF16, rows=rows, tuples=tuples)


def fp16_dot(rows: int = DEFAULT_ROWS, tuples: int | None = None):
    from .floatprog import FP16, float_dot
    return float_dot(FP16, rows=rows, tuples=tuples)


def fp8_dot(rows: int = DEFAULT_ROWS, tuples: int | None = None):
    from .floatprog import FP8_E4M3, float_dot
    return float_dot(FP8_E4M3, rows=rows, tuples=tuples)


# ---------------------------------------------------------------------------
# Registry used by benchmarks / the pim layer
# ---------------------------------------------------------------------------
GENERATORS = {
    ("add", "int4"): lambda **kw: iadd(4, **kw),
    ("add", "int8"): lambda **kw: iadd(8, **kw),
    ("add", "bf16"): lambda **kw: bf16_add(**kw),
    ("mul", "int4"): lambda **kw: imul(4, **kw),
    ("mul", "int8"): lambda **kw: imul(8, **kw),
    ("mul", "bf16"): lambda **kw: bf16_mul(**kw),
    ("dot", "int4"): lambda **kw: idot(4, **kw),
    ("dot", "int8"): lambda **kw: idot(8, **kw),
    ("add", "fp16"): lambda **kw: fp16_add(**kw),
    ("mul", "fp16"): lambda **kw: fp16_mul(**kw),
    ("add", "fp8"): lambda **kw: fp8_add(**kw),
    ("mul", "fp8"): lambda **kw: fp8_mul(**kw),
    ("add", "int16"): lambda **kw: iadd(16, **kw),
    ("mul", "int16"): lambda **kw: imul(16, **kw),
    ("dot", "int16"): lambda **kw: idot(16, **kw),
    ("dot", "bf16"): lambda **kw: bf16_dot(**kw),
    ("dot", "fp16"): lambda **kw: fp16_dot(**kw),
    ("dot", "fp8"): lambda **kw: fp8_dot(**kw),
}


# ---------------------------------------------------------------------------
# Content-addressable ops (the Jeloka prototype's TCAM/BCAM modes and
# Compute Caches' compare/search, paper §II-B): match a broadcast query
# against every column's stored word in O(nbits) cycles.
# ---------------------------------------------------------------------------
def vsearch(n: int, rows: int = DEFAULT_ROWS,
            tuples: int | None = None) -> Tuple[Program, TupleLayout]:
    """Per-tuple equality search: match[t] = (a_t == q).

    Layout per tuple: a (n rows), q (n rows, the broadcast query -- the
    host writes the same value to every column), m (1 row: match flag).
    tag-chain: start with tag=1, AND in XNOR(a_i, q_i) per bit via
    (a AND q) OR (~a AND ~q) = NOR(XOR) -- realized as two ops per bit
    using the XOR + TNROW trick: tag &= ~(a_i ^ q_i).
    """
    stride = 2 * n + 1
    T = tuples if tuples is not None else _tuples_for(rows, stride, 2)
    scratch = rows - 1                   # XOR scratch row
    scratch2 = rows - 2                  # inverted-XOR scratch row
    tuple_body = [
        Instr(OP_T1),
        MovReg(5, 4, 0),
        MovReg(6, 4, n),
        Loop(n, [
            Instr(OP_XOR, scratch, R(5), R(6), inc=((5, 1), (6, 1))),
            Instr(OP_NOT, scratch2, scratch),
            Instr(OP_TAND, a=scratch2),
        ]),
        Instr(OP_TSTORE, R(4, 2 * n)),
        AddReg(4, stride),
    ]
    nodes = [SetReg(4, 0), Loop(T, tuple_body)]
    layout = TupleLayout(n, rows, stride, T,
                         {"a": (0, n), "q": (n, n), "m": (2 * n, 1)})
    return Program(f"vsearch{n}x{T}", nodes), layout


def vcmp_gt(n: int, rows: int = DEFAULT_ROWS,
            tuples: int | None = None) -> Tuple[Program, TupleLayout]:
    """Per-tuple unsigned compare: m[t] = (a_t > b_t), via the borrow of
    b - a (borrow set <=> a > b)."""
    stride = 2 * n + 1
    T = tuples if tuples is not None else _tuples_for(rows, stride, 1)
    scratch = rows - 1
    tuple_body = [
        Instr(OP_C0),
        MovReg(5, 4, 0),
        MovReg(6, 4, n),
        Loop(n, [Instr(OP_FS, scratch, R(6), R(5),
                       inc=((5, 1), (6, 1)))]),
        Instr(OP_CSTORE, R(4, 2 * n)),
        AddReg(4, stride),
    ]
    nodes = [SetReg(4, 0), Loop(T, tuple_body)]
    layout = TupleLayout(n, rows, stride, T,
                         {"a": (0, n), "b": (n, n), "m": (2 * n, 1)})
    return Program(f"vcmp_gt{n}x{T}", nodes), layout
